"""Configuration: the JAX package's flag surface and derived rules, reused
as they are (uncrtaints_tpu.config imports no JAX)."""

from uncrtaints_tpu.config import Config, derive, input_dim  # noqa: F401
