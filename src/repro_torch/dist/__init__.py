"""Distribution layer of the port: sharding rules, compressed gradient
collectives and fault-tolerant step supervision, over
``torch.distributed`` (port of ``repro.dist``).

The port's models never see a mesh: :func:`sharding.constrain` is the
identity, as the reference's is off the mesh, and the train steps of
``repro_torch.launch.steps`` hand the models plain tensors.
"""
