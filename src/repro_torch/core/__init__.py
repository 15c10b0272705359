"""The paper's crossbar math, ported to PyTorch (mirrors ``repro.core``).

Submodules:
  quantization  transport quantizers (3-bit ADC, 8-bit errors, pulses)
  crossbar      differential-pair crossbar layer, recognition half
  mapping       layer -> 400x100 core allocation (section V.B), copied
  hw_model      analytic area/power/energy model (Tables II-IV), copied
"""
