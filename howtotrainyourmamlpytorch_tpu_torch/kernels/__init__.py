"""Hand-written Hopper kernels of the port and their wrappers.

CUDA C++ sources live in ``csrc/`` and are built at first use by
``build.py``; the Triton kernels live in ``bn_act_pool.py``; the wrappers,
launch counters and the ``autograd.Function`` live in ``conv_block.py``.
Importing this package imports neither triton nor the CUDA toolkit.
"""
