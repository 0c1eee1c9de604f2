"""The process group and the collectives over it (torch.distributed:
NCCL on the card, gloo on the CPU), and the round-robin `Communicator`."""

from dear_pytorch_tpu_torch.comm.communicator import Communicator  # noqa: F401
