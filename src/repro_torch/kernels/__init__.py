"""Hand-written Hopper kernels for the paper's compute hot-spots (the port
of ``repro.kernels``).

crossbar.py  the crossbar kernels' launchers (forward, error backprop,
             weight gradient, pulse update; stacked over cores) and their
             plain PyTorch versions
kmeans.py    the k-means assignment kernel's launcher and its plain version
flash_attention.py  the flash-attention kernels' launchers (tensor cores
             for bf16, CUDA cores for fp32) and their plain versions
             (the reference's Pallas and ``chunked_attention``
             functions)
csrc/        CUDA C++ sources, one per kernel, built for sm_90a at first use
_build.py    nvcc build into build/kernels/, keyed on the sources' hash,
             loaded with ctypes
ops.py       the public wrappers: kernel on CUDA tensors, plain version on
             CPU tensors, a launch count on each; the differentiable
             ``crossbar_matmul``; ``kmeans_assign``; ``flash_attention``;
             the crossbar tile autotuner ``block_config`` and its table
ref.py       torch oracles mirroring ``repro.kernels.ref``

Importing any of these needs neither nvcc nor a card: a library is built
and loaded inside the first call that launches it.
"""
