"""The distributed layer (counterpart of ``sfm_tpu/parallel/``): a 1-D
mesh of ranks on ``torch.distributed``, pairwise matching with the
right descriptor set sharded over the ranks, and point-partitioned
Schur bundle adjustment."""
