"""Distributed search of the port: one rank per device on
torch.distributed.

  mesh.py              the 1-D "shards" DeviceMesh, the collective
                       dispatch lock, and the exchanges (ShardExchange over
                       the mesh's process group; LocalExchange, S ranks in
                       turn on one device)
  multihost.py         process-group initialisation from the distributed
                       env contract, fleet-shape helpers
  dist_search.py       the single-block distributed engine (K1s per shard,
                       the exchange, K9)
  multihost_dryrun.py  a localhost multi-process run of TempoDB.search on
                       gloo ranks
"""
