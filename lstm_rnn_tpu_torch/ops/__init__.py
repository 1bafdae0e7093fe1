from lstm_rnn_tpu_torch.ops.activations import (  # noqa: F401
    EXP_LIMIT,
    LOG_ZERO,
    REAL_MAX,
    REAL_MIN,
    identity,
    logistic,
    safe_exp,
    tanh2,
)
from lstm_rnn_tpu_torch.ops.masking import PATTYPE_NONE, PATTYPE_FIRST, PATTYPE_NORMAL, PATTYPE_LAST  # noqa: F401
