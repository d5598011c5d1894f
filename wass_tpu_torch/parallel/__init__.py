"""The frame-sharded multi-device path: frame meshes, the process-group
bootstrap and the point-sharded bundle adjustment (counterpart of
wass_tpu/parallel/)."""

from wass_tpu_torch.parallel.mesh import Slot, local_frame_indices, make_frame_mesh  # noqa: F401
