"""Stacked and bidirectional recurrent models (counterpart of
``apex_tpu/RNN/models.py``; reference: ``apex/RNN/models.py`` and
``RNNBackend.py``, the ``LSTM`` / ``GRU`` / ``RNNReLU`` / ``RNNTanh`` /
``mLSTM`` builders over ``stackedRNN`` / ``bidirectionalRNN``).

The JAX package runs each layer-direction as one ``lax.scan``; here the
time loop is a Python loop over the steps of :mod:`.cells`. Layers stack
in order; the reversed direction flips the input, runs, and flips its
outputs back, and the two directions' features are concatenated.
Inter-layer dropout follows torch (not after the last layer) and draws
its keep mask as the JAX package does, ``bernoulli(fold_in(dropout_rng,
layer), 1 - p, shape)`` through ``utils.prng``, so the masks are JAX's
bit for bit; on a CUDA tensor the draw launches the ``threefry_bits``
kernel.
"""

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.RNN import cells as C
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike

_CELLS = {
    "lstm": (C.init_lstm_cell, C.lstm_cell, True),
    "mlstm": (C.init_mlstm_cell, C.mlstm_cell, True),
    "gru": (C.init_gru_cell, C.gru_cell, False),
    "rnn_tanh": (C.init_rnn_cell, C.rnn_tanh_cell, False),
    "rnn_relu": (C.init_rnn_cell, C.rnn_relu_cell, False),
}


class RNN:
    """``RNN(mode, input_size, hidden_size, num_layers, ...)``; apply on
    (seq, batch, input) returns (seq, batch, D * hidden) and the final
    states (D = 2 if bidirectional)."""

    def __init__(self, mode: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, *, bias: bool = True,
                 dropout: float = 0.0, bidirectional: bool = False,
                 params_dtype=torch.float32):
        if mode not in _CELLS:
            raise ValueError(f"mode must be one of {sorted(_CELLS)}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bias = bias
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.params_dtype = params_dtype
        self.init_cell, self.cell, self.has_cell_state = _CELLS[mode]

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> List[Dict[str, Any]]:
        """One dict a layer, ``{"fwd": cell params}`` and, when
        bidirectional, ``"bwd"``; drawn from ``generator`` in layer and
        direction order."""
        d = 2 if self.bidirectional else 1
        layers = []
        for li in range(self.num_layers):
            in_sz = self.input_size if li == 0 else self.hidden_size * d
            layer = {"fwd": self.init_cell(generator, in_sz,
                                           self.hidden_size,
                                           self.params_dtype, self.bias,
                                           device=device)}
            if self.bidirectional:
                layer["bwd"] = self.init_cell(generator, in_sz,
                                              self.hidden_size,
                                              self.params_dtype, self.bias,
                                              device=device)
            layers.append(layer)
        return layers

    def _zero_state(self, batch: int, like: torch.Tensor):
        h = torch.zeros((batch, self.hidden_size), dtype=like.dtype,
                        device=like.device)
        return (h, torch.zeros_like(h)) if self.has_cell_state else h

    def _run_direction(self, p, xs, reverse: bool):
        if reverse:
            xs = torch.flip(xs, dims=(0,))
        state = self._zero_state(xs.shape[1], xs)
        hs = []
        for t in range(xs.shape[0]):
            state = self.cell(p, xs[t], state)
            hs.append(state[0] if self.has_cell_state else state)
        hs = torch.stack(hs)
        if reverse:
            hs = torch.flip(hs, dims=(0,))
        return hs, state

    def apply(self, params: List[Dict[str, Any]], xs: torch.Tensor, *,
              dropout_rng: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, List[Any]]:
        finals = []
        for li, layer in enumerate(params):
            hs_f, fin_f = self._run_direction(layer["fwd"], xs, False)
            if self.bidirectional:
                hs_b, fin_b = self._run_direction(layer["bwd"], xs, True)
                xs = torch.cat([hs_f, hs_b], dim=-1)
                finals.append((fin_f, fin_b))
            else:
                xs = hs_f
                finals.append(fin_f)
            if (dropout_rng is not None and self.dropout > 0
                    and li < self.num_layers - 1):
                keep = prng.bernoulli(prng.fold_in(dropout_rng, li),
                                      1 - self.dropout, tuple(xs.shape),
                                      device=xs.device)
                # the scale in xs's dtype, as JAX's weakly typed scalar
                xs = xs * keep / torch.tensor(1 - self.dropout,
                                              dtype=xs.dtype,
                                              device=xs.device)
        return xs, finals

    __call__ = apply


LSTM = functools.partial(RNN, "lstm")
mLSTM = functools.partial(RNN, "mlstm")
GRU = functools.partial(RNN, "gru")


def RNNReLU(*args, **kw):
    return RNN("rnn_relu", *args, **kw)


def RNNTanh(*args, **kw):
    return RNN("rnn_tanh", *args, **kw)
