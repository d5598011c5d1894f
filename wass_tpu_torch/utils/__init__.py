from wass_tpu_torch.utils.progress import progress  # noqa: F401
from wass_tpu_torch.utils.timer import StageTimer  # noqa: F401
