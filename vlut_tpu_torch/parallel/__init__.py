"""Multi-device serving on ``torch.distributed`` (port of vlut_tpu/parallel).

One process per device.  A :class:`~vlut_tpu_torch.parallel.sharding.Mesh`
names the axes ("dp", "tp"; or "ep", "sp", "pp") over the processes of the
default group, and holds this rank's coordinates, its device and one
process group per axis.  Each rank keeps its own shard of the weights
(``sharding.shard_params``) and the forward issues the collectives of the
JAX package's ``shard_map`` bodies itself (``_comm``: psum, pmax,
all_gather, ppermute), so ``spmd.make_forward_*`` and
``pipeline.make_forward_pp`` return functions every rank calls on its
shard.  The backend is the caller's: NCCL on the card, gloo on the CPU (or,
two ranks sharing one card, gloo on CUDA tensors).
"""
