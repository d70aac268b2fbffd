"""Training across processes on ``torch.distributed``: the bootstrap, the
("data", "model") mesh with its parameter rules, and the tensor-parallel
pieces of the encoder.

Counterpart of the JAX package's ``parallel/``. GSPMD partitions one
program over a mesh there; here each process is one rank of the mesh and
the collectives are explicit: the data dimension all-reduces gradients
(data parallelism) or reduce-scatters them (FSDP, ``fully_shard``), and the
model dimension splits the encoder layers' heads and FFN (Megatron-style,
``tensor_parallel.py``).
"""
