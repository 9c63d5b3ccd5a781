"""The JAX package's static analyzer (graftlint, ``ray_tpu/tools/lint``)
run over the port, ``ray_tpu_torch/``, against the port's own baseline
(``tests/torch_lint_baseline.json``; the JAX package's baseline is not
used or edited).

Every baselined finding is code the port copied from the JAX runtime
unchanged, and its entry says why the JAX baseline's reason carries
over. The baseline records the port's wire-op hash under the port's own
``PROTOCOL_VERSION``, so a change to the port's wire ops without a
version bump fails here. The doc-sync check is off (no doc roots):
``docs/`` describes the JAX package's ``ray_tpu_*`` metric names, and the
port's ``port_*`` names are documented in its modules.

This test imports ``ray_tpu`` (the analyzer); the port never does.
"""

import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "tests", "torch_lint_baseline.json")


def test_port_lint_is_clean_against_its_baseline():
    from ray_tpu.tools.lint.cli import run_lint

    report = run_lint(root=os.path.join(REPO, "ray_tpu_torch"),
                      baseline_path=BASELINE, doc_roots=[],
                      use_cache=False)
    assert not report.parse_errors, report.parse_errors
    assert not report.unbaselined, "\n".join(
        f.render() for f in report.unbaselined)
    assert not report.stale_baseline_keys, report.stale_baseline_keys

    from ray_tpu_torch.core.protocol import PROTOCOL_VERSION

    with open(BASELINE) as f:
        baseline = json.load(f)
    assert baseline["protocol"] == {"version": PROTOCOL_VERSION,
                                    "ops_hash": report.ops_hash}
    # the finalizer that took a lock is gone: no GC-reentrancy entry
    assert not [k for k in baseline["findings"]
                if k.startswith("gc-reentrancy")]
    assert all(j.strip() for j in baseline["findings"].values())
