"""Hand-written Hopper kernels for the paper's compute hot-spots (the port
of ``repro.kernels``).

crossbar.py  the crossbar forward kernel's launcher and its plain PyTorch
             version (y = ADC(h(x @ (G+ - G-))), stacked over cores)
csrc/        CUDA C++ sources, built for sm_90a at first use
_build.py    nvcc build into build/kernels/, keyed on the sources' hash,
             loaded with ctypes
ops.py       the public wrappers: kernel on CUDA tensors, plain version on
             CPU tensors, a launch count on each
ref.py       torch oracles mirroring ``repro.kernels.ref``

Importing any of these needs neither nvcc nor a card: the library is built
and loaded inside the first call that launches it.
"""
