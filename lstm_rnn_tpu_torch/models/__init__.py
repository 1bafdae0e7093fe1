"""Layers of the port: models/lstm.py (LSTM/BLSTM), models/feedforward.py
(feedforward and softmax), models/losses.py (the post-output layers),
models/flagship.py (the TIMIT recipe)."""
