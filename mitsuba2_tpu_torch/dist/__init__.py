"""Multi-process rendering and long renders (counterpart of
mitsuba2_tpu/dist/): `sharding` splits each pass's samples over the
ranks of a torch.distributed group and all-reduces the film and the
gradients, `multihost` starts the group, `checkpoint` saves and resumes
long renders and optimizations."""
from . import sharding  # noqa: F401
