"""The port's version: the JAX package's release it mirrors (elasticity
checks a target version against its minimum)."""

version = "0.3.10+tpu.r1"
