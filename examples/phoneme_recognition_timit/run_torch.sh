#!/bin/sh
# The recipe on the PyTorch port (lstm_rnn_tpu_torch), which trains on
# the GPU: run.sh with the port's CLI and data generator.
# Real TIMIT data comes from htk2nc (see mkmap.py / mlf2label.py); fall back
# to a synthetic shape-compatible corpus so the recipe runs out of the box.
[ -f ../alignments/timit_trainD117.nc ] && [ -f ../alignments/timit_cvD117.nc ] \
  || python ../make_example_data_torch.py timit
python -m lstm_rnn_tpu_torch.cli config.cfg "$@"
