"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the dispatch the rest of the package calls: a CPU tensor goes
to the plain PyTorch version in ``ref``; a CUDA tensor goes to the
kernel, and any failure raises.  Kernel modules import no compiler at
import time: the CUDA sources are built by ``build`` on the first launch.
"""
