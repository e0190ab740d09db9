"""Functional RNN cells (counterpart of ``apex_tpu/RNN/cells.py``;
reference: ``apex/RNN/cells.py``, the fp16-era ``mLSTMRNNCell`` /
``mLSTMCell`` and the torch builtins its backend wraps).

Cells are step functions ``(params, x_t, state) -> state`` that
:mod:`apex_tpu_torch.RNN.models` drives over time. The gate products are
packed, ``(in, n * hidden)`` and ``(hidden, n * hidden)``, so a step is
two GEMMs; the gates follow torch's order (LSTM: i, f, g, o; GRU: r, z,
n). Gate math runs in fp32 whatever the storage dtype (the tier's
purpose: fp16-safe recurrences), or wider for float64 tensors, and the
new state is cast back to the state's own dtype.
"""

import math
from typing import Dict, Tuple

import torch

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """At least fp32: bf16 and fp16 widen, fp32 and float64 stay."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _uniform(generator, shape, bound, dtype, dev):
    return ((torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0)
            * bound).to(dtype)


def _init_gates(generator, input_size, hidden_size, n_gates, dtype,
                device, bias=True):
    """Packed torch-style init: U(-1/sqrt(H), 1/sqrt(H))."""
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(hidden_size)
    p = {
        "w_ih": _uniform(generator, (input_size, n_gates * hidden_size),
                         bound, dtype, dev),
        "w_hh": _uniform(generator, (hidden_size, n_gates * hidden_size),
                         bound, dtype, dev),
    }
    if bias:
        p["b_ih"] = _uniform(generator, (n_gates * hidden_size,), bound,
                             dtype, dev)
        p["b_hh"] = _uniform(generator, (n_gates * hidden_size,), bound,
                             dtype, dev)
    return p


def _gates(p: Params, x, h):
    g = x @ p["w_ih"].to(x.dtype) + h @ p["w_hh"].to(h.dtype)
    if "b_ih" in p:
        g = g + p["b_ih"].to(g.dtype) + p["b_hh"].to(g.dtype)
    return _wide(g)


def _lstm_update(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * _wide(c) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


# -- LSTM -------------------------------------------------------------------

def init_lstm_cell(generator: torch.Generator, input_size: int,
                   hidden_size: int, dtype=torch.float32, bias: bool = True,
                   device: DeviceLike = None) -> Params:
    return _init_gates(generator, input_size, hidden_size, 4, dtype,
                       device, bias)


def lstm_cell(p: Params, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, c) -> (h', c'); torch gate order i, f, g, o."""
    h, c = state
    h_new, c_new = _lstm_update(_gates(p, x, h), c)
    return h_new.to(h.dtype), c_new.to(c.dtype)


# -- mLSTM (multiplicative LSTM, the reference's own cell) ------------------

def init_mlstm_cell(generator: torch.Generator, input_size: int,
                    hidden_size: int, dtype=torch.float32, bias: bool = True,
                    device: DeviceLike = None) -> Params:
    p = _init_gates(generator, input_size, hidden_size, 4, dtype, device,
                    bias)
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(hidden_size)
    p["w_mih"] = _uniform(generator, (input_size, hidden_size), bound,
                          dtype, dev)
    p["w_mhh"] = _uniform(generator, (hidden_size, hidden_size), bound,
                          dtype, dev)
    return p


def mlstm_cell(p: Params, x: torch.Tensor,
               state: Tuple[torch.Tensor, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Krause et al.'s multiplicative LSTM (ref ``mLSTMCell``): the
    hidden state is replaced by m = (x Wmx) * (h Wmh) before the LSTM
    gates."""
    h, c = state
    m = (x @ p["w_mih"].to(x.dtype)) * (h @ p["w_mhh"].to(h.dtype))
    h_new, c_new = _lstm_update(_gates(p, x, m), c)
    return h_new.to(h.dtype), c_new.to(c.dtype)


# -- GRU --------------------------------------------------------------------

def init_gru_cell(generator: torch.Generator, input_size: int,
                  hidden_size: int, dtype=torch.float32, bias: bool = True,
                  device: DeviceLike = None) -> Params:
    return _init_gates(generator, input_size, hidden_size, 3, dtype,
                       device, bias)


def gru_cell(p: Params, x: torch.Tensor, state: torch.Tensor
             ) -> torch.Tensor:
    """torch's GRU: r and z from the packed gates; n mixes b_ih and b_hh
    asymmetrically (b_hh inside r's product)."""
    h = state
    gi = x @ p["w_ih"].to(x.dtype)
    gh = h @ p["w_hh"].to(h.dtype)
    if "b_ih" in p:
        gi = gi + p["b_ih"].to(gi.dtype)
        gh = gh + p["b_hh"].to(gh.dtype)
    gi, gh = _wide(gi), _wide(gh)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = (1.0 - z) * n + z * _wide(h)
    return h_new.to(h.dtype)


# -- vanilla RNN ------------------------------------------------------------

def init_rnn_cell(generator: torch.Generator, input_size: int,
                  hidden_size: int, dtype=torch.float32, bias: bool = True,
                  device: DeviceLike = None) -> Params:
    return _init_gates(generator, input_size, hidden_size, 1, dtype,
                       device, bias)


def rnn_tanh_cell(p: Params, x: torch.Tensor, state: torch.Tensor
                  ) -> torch.Tensor:
    return torch.tanh(_gates(p, x, state)).to(state.dtype)


def rnn_relu_cell(p: Params, x: torch.Tensor, state: torch.Tensor
                  ) -> torch.Tensor:
    return torch.relu(_gates(p, x, state)).to(state.dtype)
