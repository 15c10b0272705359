"""Hand-written Hopper kernels for the paper's compute hot-spots (the port
of ``repro.kernels``).

crossbar.py  the crossbar kernels' launchers (forward, error backprop,
             weight gradient, pulse update; stacked over cores) and their
             plain PyTorch versions
csrc/        CUDA C++ sources, one per kernel, built for sm_90a at first use
_build.py    nvcc build into build/kernels/, keyed on the sources' hash,
             loaded with ctypes
ops.py       the public wrappers: kernel on CUDA tensors, plain version on
             CPU tensors, a launch count on each; the differentiable
             ``crossbar_matmul``
ref.py       torch oracles mirroring ``repro.kernels.ref``

Importing any of these needs neither nvcc nor a card: a library is built
and loaded inside the first call that launches it.
"""
