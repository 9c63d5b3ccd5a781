"""Port parity: the training half of ray_tpu_torch.models.llama against
ray_tpu.models.llama.

Set-up: LlamaConfig.debug() on both sides, JAX ``init_params`` carried
over with ``params_from_numpy``, token ids made with numpy from a seed.
JAX runs on the CPU (its flash_attention takes the exact path there), the
port on the CPU (its FlashAttention autograd.Function takes the plain
forward and backward there).

Tolerances:
- loss and leaf-by-leaf grads, float32: rtol = atol = 1e-4 (the same
  float32 arithmetic in another order, through two layers and the
  chunked head);
- train-step losses over three steps: rtol 1e-4 in float32, 3e-3 in
  bfloat16 (the JAX suite's train-step bound, tests/test_spmd_train.py:
  bf16 rounds at other places in the two frameworks);
- remat on/off and chunked/unchunked on the port alone: 1e-6 (the same
  arithmetic recomputed, or summed in chunks);
- the default optimizer against optax's adamw on the same params and
  grads: rtol 1e-6, atol 1e-9 (one float32 update formula, evaluated in
  another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu_torch.models import llama as tl

F32 = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# T = 20 with 8-token chunks: two chunks and a remainder of 4
LOSS_CHUNK = 8


@pytest.fixture(scope="module")
def jax_tree():
    cfg = dataclasses.replace(jl.LlamaConfig.debug(), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jl.init_params(cfg, jax.random.PRNGKey(0)))


def _cfgs(name, **kw):
    jdt, tdt = DTYPES[name]
    return (dataclasses.replace(jl.LlamaConfig.debug(), dtype=jdt, **kw),
            dataclasses.replace(tl.LlamaConfig.debug(), dtype=tdt, **kw))


def _tokens(B, T, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)) \
        .astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _port_loss_and_grads(tcfg, jax_tree, toks):
    model = tl.params_from_numpy(tcfg, jax_tree, device="cpu")
    loss = tl.loss_fn(tcfg, model.tree(), torch.from_numpy(toks))
    loss.backward()
    return loss.detach(), {n.replace(".", "/"): p.grad
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(jax_tree, remat):
    jcfg, tcfg = _cfgs("f32", loss_chunk=LOSS_CHUNK, remat=remat)
    toks = _tokens(2, 21, jcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(jcfg, p, jnp.asarray(toks))))(
            jax.tree.map(jnp.asarray, jax_tree))
    loss, grads = _port_loss_and_grads(tcfg, jax_tree, toks)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **F32)
    jflat = _flat(jgrads)
    assert set(grads) == set(jflat)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]),
                                   err_msg=path, **F32)


@pytest.mark.parametrize("other", [dict(remat=True),
                                   dict(loss_chunk=0)])
def test_remat_and_chunking_keep_loss_and_grads(jax_tree, other):
    _, base = _cfgs("f32", loss_chunk=LOSS_CHUNK, remat=False)
    toks = _tokens(2, 21, base.vocab_size, seed=1)
    loss0, grads0 = _port_loss_and_grads(base, jax_tree, toks)
    loss1, grads1 = _port_loss_and_grads(
        dataclasses.replace(base, **other), jax_tree, toks)
    torch.testing.assert_close(loss1, loss0, atol=1e-6, rtol=1e-6)
    for path, g in grads0.items():
        torch.testing.assert_close(grads1[path], g, atol=1e-6, rtol=1e-6,
                                   msg=path)


def test_param_logical_axes_match_jax():
    for preset in ("debug", "llama3_1b"):
        jcfg, tcfg = (getattr(m.LlamaConfig, preset)() for m in (jl, tl))
        assert tl.param_logical_axes(tcfg) == jl.param_logical_axes(jcfg)
    tied = dataclasses.replace(tl.LlamaConfig.debug(), tie_embeddings=True)
    assert "lm_head" not in tl.param_logical_axes(tied)


@pytest.mark.parametrize("name,rtol", [("f32", 1e-4), ("bf16", 3e-3)])
def test_train_step_losses_match_jax(name, rtol):
    jcfg, tcfg = _cfgs(name, remat=True)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1))
    jinit, jstep, data_sharding, _ = jl.make_train_step(jcfg, mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jstate["params"])
    toks = _tokens(4, 17, jcfg.vocab_size, seed=2)
    jtoks = jax.device_put(toks, data_sharding)
    init, step = tl.make_train_step(tcfg, device="cpu")
    state = init(tree)
    want, got = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jtoks)
        want.append(float(loss))
        got.append(float(step(state, torch.from_numpy(toks))))
    assert state["step"] == 3
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_default_optimizer_is_optax_adamw():
    """Three updates of the step's default optimizer equal optax.adamw at
    the JAX step's settings, weight decay on every leaf included: the
    losses of three steps cannot tell betas or decay apart."""
    init, _ = tl.make_train_step(tl.LlamaConfig.debug(), device="cpu")
    state = init(0)
    model, opt = state["params"], state["opt_state"]
    want = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    opt_state = tx.init(want)
    rng = np.random.RandomState(3)
    for _ in range(3):
        grads = {n: (rng.randn(*v.shape) * rng.choice([1e-3, 1.0])
                     ).astype(np.float32) for n, v in want.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        updates, opt_state = tx.update(grads, opt_state, want)
        want = optax.apply_updates(want, updates)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-9, err_msg=n)


def test_loss_decreases_quickly_overfit():
    """The mirror of tests/test_llama.py's overfit test: 30 steps on one
    repeated batch halve the loss."""
    init, step = tl.make_train_step(tl.LlamaConfig.debug(), device="cpu")
    state = init(0)
    tokens = torch.arange(32).repeat(4, 1)
    losses = [float(step(state, tokens)) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, f"{losses[0]} -> {losses[-1]}"


def test_train_step_goes_through_the_flash_attention_function(monkeypatch):
    """The backbone's attention is the FlashAttention autograd.Function,
    so on the card the step reaches the backward kernels."""
    cfg = tl.LlamaConfig.debug()
    init, step = tl.make_train_step(cfg, device="cpu")
    state = init(0)
    seen = []
    orig = tl.flash_attention

    def spy(q, k, v, causal=True):
        out = orig(q, k, v, causal)
        seen.append(type(out.grad_fn).__name__)
        return out

    monkeypatch.setattr(tl, "flash_attention", spy)
    step(state, torch.zeros(2, 9, dtype=torch.long))
    assert seen == ["FlashAttentionBackward"] * cfg.n_layers
    assert all(p.grad is not None for p in state["params"].parameters())
