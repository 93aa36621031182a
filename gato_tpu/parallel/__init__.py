"""Multi-device execution: shard_map over a jax.sharding.Mesh.

The reference has no multi-device story at all (its 'distributed' axis is CUDA
blocks <-> knot points inside one GPU, synchronized by cooperative grid
barriers).  Here the same knot axis shards across devices: lax.ppermute halo
exchange for the block-tridiagonal matvec (bandwidth-1 neighbor comm, the
analog of loadBlockTriDiagonal's neighbor loads), lax.psum for the PCG dot
products (the analog of the atomicAdd scalar all-reduce), and plain batch
sharding for fleets of independent problems.
"""
