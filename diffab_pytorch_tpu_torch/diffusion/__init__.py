"""Schedule and the three diffusions (sequence, coordinates, orientations)."""

from diffab_pytorch_tpu_torch.diffusion import coordinate, orientation, sequence
from diffab_pytorch_tpu_torch.diffusion.coordinate import CoordinateDiffuser
from diffab_pytorch_tpu_torch.diffusion.orientation import (
    OrientationDiffuser,
    OrientationDiffusionTables,
    make_orientation_tables,
)
from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule, cosine_variance_schedule
from diffab_pytorch_tpu_torch.diffusion.sequence import SequenceDiffuser
