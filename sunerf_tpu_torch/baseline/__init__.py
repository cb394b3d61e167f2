"""Classical (non-ML) baselines of the port (sunerf_tpu/baseline)."""
