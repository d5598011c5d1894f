from wass_tpu_torch.utils.progress import progress  # noqa: F401
