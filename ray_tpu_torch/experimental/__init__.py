"""Experimental subsystems (port of ``ray_tpu/experimental``; reference:
ray.experimental): the compiled graphs' ring channels."""
