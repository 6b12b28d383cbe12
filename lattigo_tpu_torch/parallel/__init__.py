"""The multi-rank layer: a (party, data) mesh of ``torch.distributed``
process groups, the threshold protocols run one party a rank, the
cross-rank four-step NTT, the weak-scaling harness, and the launcher that
starts a world of rank processes on one host.

Counterpart of ``lattigo_tpu/parallel/``: where the JAX package maps a
function over a ``jax.sharding.Mesh`` with ``shard_map``, the port runs one
process per rank (SPMD) and meets the other ranks in collectives."""
