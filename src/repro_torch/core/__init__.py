"""The paper's crossbar math, ported to PyTorch (mirrors ``repro.core``).

Submodules:
  quantization  transport quantizers (3-bit ADC, 8-bit errors, pulses)
  crossbar      differential-pair crossbar layer + paper training rule
  mapping       layer -> 400x100 core allocation (section V.B), copied
  hw_model      analytic area/power/energy model (Tables II-IV), copied
  autoencoder   layer-wise pretraining + supervised fine-tune
  kmeans        Manhattan-distance clustering (the digital core)
  anomaly       reconstruction-error anomaly detection
"""
from repro_torch.core.crossbar import (  # noqa: F401
    CrossbarSpec,
    crossbar_apply,
    hard_sigmoid,
    init_conductances,
    mlp_forward,
    paper_backprop_step,
    paper_backprop_step_scan,
    stack_layers,
    unstack_layers,
)
from repro_torch.core.quantization import (  # noqa: F401
    QTensor,
    adc_quantize,
    adc_quantize_ste,
    error_quantize,
    error_quantize_ste,
    fake_quant,
    pulse_discretize,
)
from repro_torch.data.synthetic import (  # noqa: F401
    gaussian_mixture,
    iris_like,
    kdd_like,
    mnist_like,
    isolet_like,
)
