"""Paper Table I application configurations + default crossbar spec."""
from repro_torch.core.crossbar import CrossbarSpec

# Table I: neural network configurations.
NETWORKS = {
    "kdd_anomaly": [41, 15, 41],
    "mnist_class": [784, 300, 200, 100, 10],
    "isolet_class": [617, 2000, 1000, 500, 250, 26],
    "mnist_dimred": [784, 300, 200, 100, 20],
    "isolet_dimred": [617, 2000, 1000, 500, 250, 20],
    "iris_ae": [4, 2, 4],
    "iris_class": [4, 10, 1],      # section VI.A: 4 -> 10 hidden -> 1 output
}

# Paper-faithful constraints (Fig. 21: 3-bit outputs, 8-bit errors).
PAPER_SPEC = CrossbarSpec(adc_bits=3, err_bits=8,
                          transport_quant=True, error_quant=True,
                          update_quant=True)

# Unconstrained float baseline (the "without constraints" bars of Fig. 21).
FLOAT_SPEC = CrossbarSpec(transport_quant=False, error_quant=False,
                          update_quant=False)
