"""diffab_pytorch_tpu_torch — the PyTorch and CUDA port of diffab_pytorch_tpu.

The JAX package beside it is the reference this port is held against; the
port imports torch and numpy only, never JAX or the JAX package.  Entry
points run on the CUDA card unless the caller passes device="cpu".

    from diffab_pytorch_tpu_torch import DiffAbModel, default_config, sample
    from diffab_pytorch_tpu_torch import DiffAb, fit, production_config
"""

__version__ = "0.1.0"

from diffab_pytorch_tpu_torch.config import (
    DataConfig,
    DiffAbConfig,
    DiffusionConfig,
    ModelConfig,
    TrainConfig,
    default_config,
    production_config,
    resolve_device,
    tiny_config,
)
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult, sample
from diffab_pytorch_tpu_torch.train.harness import DiffAb, TrainState
from diffab_pytorch_tpu_torch.train.trainer import fit
