"""Multi-GPU training over a (data, tiles) mesh on ``torch.distributed``
(counterpart of ``gscream_tpu/parallel``): one process drives one card."""
