"""The process group and the collectives over it (torch.distributed:
NCCL on the card, gloo on the CPU)."""
