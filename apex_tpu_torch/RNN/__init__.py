"""Recurrent cells and stacks (counterpart of ``apex_tpu/RNN``)."""

from apex_tpu_torch.RNN.cells import (  # noqa: F401
    gru_cell,
    init_gru_cell,
    init_lstm_cell,
    init_mlstm_cell,
    init_rnn_cell,
    lstm_cell,
    mlstm_cell,
    rnn_relu_cell,
    rnn_tanh_cell,
)
from apex_tpu_torch.RNN.models import (  # noqa: F401
    GRU,
    LSTM,
    RNN,
    RNNReLU,
    RNNTanh,
    mLSTM,
)
