#!/bin/sh
# The recipe on the PyTorch port (lstm_rnn_tpu_torch), which trains on
# the GPU: run.sh with the port's CLI and data generator.
# Generate synthetic data on first run (the reference's train blobs were
# stripped from its repo too; see ../../make_example_data_torch.py).
[ -f ../train_1_speaker.nc ] && [ -f ../val_1_speaker.nc ] \
  || python ../../make_example_data_torch.py chime_recognition
python -m lstm_rnn_tpu_torch.cli config.cfg "$@"
