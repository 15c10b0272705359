"""Autoencoder with layer-wise unsupervised pretraining (paper section
III.C-E; port of ``repro.core.autoencoder``).

The paper trains deep networks by (1) greedily pretraining each hidden layer
as a two-layer autoencoder — the temporarily-added decoder "tries to learn
the inputs applied to the first layer" — then (2) stacking the encoders and
fine-tuning with supervised backprop.  Both phases run under the crossbar
constraints (3-bit transport, 8-bit errors, pulse updates) when
``spec`` enables them.

Every random draw (initial conductances, one permutation of the samples
per epoch) comes from the ``torch.Generator`` passed first, in place of the
reference's key; a deterministic body (``*_from``) takes the drawn arrays,
so tests can hand it the reference's draws.  Training runs on the device of
the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core import crossbar as xb
from repro_torch.core import quantization as q
from repro_torch.core.crossbar import CrossbarSpec

Layer = dict[str, torch.Tensor]


def init_mlp(generator: torch.Generator, dims: list[int], spec: CrossbarSpec,
             *, device: str | torch.device = "cuda") -> list[Layer]:
    """Random conductances for the layers of ``dims``, in layer order."""
    return [xb.init_conductances(i, o, spec, generator=generator,
                                 device=device)
            for i, o in zip(dims, dims[1:])]


def encode(layers: list[Layer], x: torch.Tensor,
           spec: CrossbarSpec) -> torch.Tensor:
    """The encoder stack's output for ``x``, on ``x``'s device."""
    return xb.mlp_forward(layers, x, spec, device=x.device)


def reconstruction(enc_layers, dec_layer, x, spec: CrossbarSpec
                   ) -> torch.Tensor:
    """decoder(encoder(x))."""
    h = encode(enc_layers, x, spec)
    return xb.crossbar_apply(dec_layer, h, spec)


def permutations(generator: torch.Generator, n: int, epochs: int,
                 device: torch.device) -> list[torch.Tensor]:
    """One permutation of range(n) per epoch, drawn on the generator's
    device and moved to ``device``."""
    return [torch.randperm(n, generator=generator,
                           device=generator.device).to(device)
            for _ in range(epochs)]


def batches(perm: torch.Tensor, batch: int) -> torch.Tensor:
    """An epoch's sample indices, (n // batch, batch); the ragged rest of
    the permutation is dropped, as in the reference."""
    n = perm.shape[0]
    return perm[: (n // batch) * batch].reshape(-1, batch)


def _draw_pair(generator, x, fan_in, hidden, spec, epochs):
    """An (encoder, decoder) pair's draws on ``x``'s device: the encoder's
    conductances, the decoder's, then one permutation per epoch."""
    enc, dec = (xb.init_conductances(i, o, spec, generator=generator,
                                     device=x.device)
                for i, o in ((fan_in, hidden), (hidden, fan_in)))
    return enc, dec, permutations(generator, x.shape[0], epochs, x.device)


def _ae_bp(enc, dec, x, spec, lr):
    layers, err = xb.paper_backprop_step([enc, dec], x, x, spec, lr)
    return (layers[0], layers[1]), err


def pretrain_layer_from(enc: Layer, dec: Layer, x_repr: torch.Tensor,
                        perms: list[torch.Tensor], spec: CrossbarSpec, *,
                        lr: float, batch: int
                        ) -> tuple[Layer, Layer, torch.Tensor]:
    """The body of :func:`pretrain_layer` on given draws: from ``enc`` and
    ``dec``, one epoch per permutation in ``perms``, one paper
    backprop step per batch.  Returns (enc, dec, losses[epochs]), each loss
    the epoch's mean of the batches' mean squared errors."""
    losses = []
    for perm in perms:
        errs = []
        for idx in batches(perm, batch):
            (enc, dec), err = _ae_bp(enc, dec, x_repr[idx], spec, lr)
            errs.append(torch.mean(err ** 2))
        losses.append(torch.stack(errs).mean())
    return enc, dec, torch.stack(losses)


def pretrain_layer(generator: torch.Generator, x_repr: torch.Tensor,
                   fan_in: int, hidden: int, spec: CrossbarSpec, *,
                   lr: float, epochs: int, batch: int
                   ) -> tuple[Layer, Layer, torch.Tensor]:
    """Train one (encoder, temp-decoder) pair so decoder(encoder(x)) ~ x.

    Returns (encoder_params, decoder_params, losses[epochs]).  Uses the
    paper's stochastic-BP circuit rule (crossbar.paper_backprop_step).
    Draws the encoder's, then the decoder's conductances, then one
    permutation per epoch from ``generator``.
    """
    enc, dec, perms = _draw_pair(generator, x_repr, fan_in, hidden, spec,
                                 epochs)
    return pretrain_layer_from(enc, dec, x_repr, perms, spec, lr=lr,
                               batch=batch)


def pretrain_stack_from(x: torch.Tensor,
                        draws: list[tuple[Layer, Layer, list[torch.Tensor]]],
                        spec: CrossbarSpec, *, lr: float = 0.05,
                        batch: int = 16
                        ) -> tuple[list[Layer], list[torch.Tensor]]:
    """The body of :func:`pretrain_stack` on given draws: one (enc, dec,
    perms) per layer, as :func:`pretrain_layer_from` takes them."""
    enc_layers: list[Layer] = []
    curves: list[torch.Tensor] = []
    # Invariant: repr_x is exactly what the next core receives — the raw
    # DAC-driven input at level 0, transport-quantized activations after.
    repr_x = x
    for enc, dec, perms in draws:
        enc, _dec, losses = pretrain_layer_from(enc, dec, repr_x, perms,
                                                spec, lr=lr, batch=batch)
        enc_layers.append(enc)
        curves.append(losses)
        repr_x = xb.crossbar_apply(enc, repr_x, spec, transport_in=False)
        if spec.transport_quant:   # the representation rides the network
            repr_x = q.adc_quantize_ste(repr_x, spec.adc_bits)
    return enc_layers, curves


def pretrain_stack(generator: torch.Generator, x: torch.Tensor,
                   dims: list[int], spec: CrossbarSpec, *, lr: float = 0.05,
                   epochs: int = 20, batch: int = 16
                   ) -> tuple[list[Layer], list[torch.Tensor]]:
    """Greedy layer-wise pretraining over ``dims`` (dims[0] = input dim).

    Returns (encoder_layers, per-layer loss curves).  Representations feed
    forward through already-trained encoders, as in the paper.  Each
    layer's draws come from ``generator`` in layer order, as
    :func:`pretrain_layer` makes them.
    """
    draws = [_draw_pair(generator, x, fi, h, spec, epochs)
             for fi, h in zip(dims, dims[1:])]
    return pretrain_stack_from(x, draws, spec, lr=lr, batch=batch)


def finetune_supervised_from(layers: list[Layer], x: torch.Tensor,
                             y: torch.Tensor, perms: list[torch.Tensor],
                             spec: CrossbarSpec, *, lr: float = 0.05,
                             batch: int = 16
                             ) -> tuple[list[Layer], torch.Tensor]:
    """The body of :func:`finetune_supervised` on given permutations (one
    per epoch).  Returns (layers, curve[epochs])."""
    layers = list(layers)
    curve = []
    for perm in perms:
        errs = []
        for idx in batches(perm, batch):
            layers, err = xb.paper_backprop_step(layers, x[idx], y[idx],
                                                 spec, lr)
            errs.append(torch.mean(err ** 2))
        curve.append(torch.stack(errs).mean())
    return layers, torch.stack(curve)


def finetune_supervised(generator: torch.Generator, layers: list[Layer],
                        x: torch.Tensor, y: torch.Tensor, spec: CrossbarSpec,
                        *, lr: float = 0.05, epochs: int = 30,
                        batch: int = 16
                        ) -> tuple[list[Layer], torch.Tensor]:
    """Supervised fine-tuning of the pretrained stack (paper section II:
    "supervised fine tuning is performed on the pre trained weights").
    One permutation per epoch comes from ``generator``."""
    perms = permutations(generator, x.shape[0], epochs, x.device)
    return finetune_supervised_from(layers, x, y, perms, spec, lr=lr,
                                    batch=batch)
