from pandelos_tpu_torch.native.loader import native_available  # noqa: F401
