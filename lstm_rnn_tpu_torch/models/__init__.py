"""Layers of the port: models/lstm.py (LSTM/BLSTM), models/feedforward.py
(feedforward and softmax), models/losses.py (the post-output layers),
models/blocks.py (an LSTM layer in time blocks on the carry kernels:
sequence parallelism and --remat_blocks), models/flagship.py (the TIMIT
recipe)."""
