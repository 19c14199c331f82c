"""The benchmark's plain reference: what each cell's timed path computes,
worked out again without the program.

Every module here is a frozen copy of the port's plain PyTorch code
(``core/{fastb,threefry}.py``, ``models/mlp.py``, ``learn/ppo.py``,
``eval/harness.py``'s policy loop, the parity engine), with the kernel
dispatch, the sharding and the other engines taken out.  It imports
nothing of the program and nothing of JAX: the check that decides
``correct`` compares the program's outputs with these, which later
changes to the program cannot move.
"""
