"""Self-supervised pretraining core: states, the CP2 objective and step."""

from cp2_tpu_torch.ssl.hparams import SSLHyperParams
from cp2_tpu_torch.ssl.model import SSLEncoder, output_stride_of
from cp2_tpu_torch.ssl.state import PretrainState, create_pretrain_state
from cp2_tpu_torch.ssl.queue import queue_enqueue

__all__ = [
    "SSLHyperParams",
    "SSLEncoder",
    "output_stride_of",
    "PretrainState",
    "create_pretrain_state",
    "queue_enqueue",
]
