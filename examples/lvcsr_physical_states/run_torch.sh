#!/bin/sh
# The recipe on the PyTorch port (lstm_rnn_tpu_torch), which trains on
# the GPU: run.sh with the port's CLI and data generator.
# Train the LVCSR physical-state DBLSTM (see config.cfg for real-data
# prep via htk2nc --no_label_map); fall back to a synthetic
# shape-compatible corpus so the recipe runs out of the box.
[ -f ../alignments/lvcsr_train_states.nc ] && [ -f ../alignments/lvcsr_cv_states.nc ] \
  || python ../make_example_data_torch.py lvcsr
python -m lstm_rnn_tpu_torch.cli config.cfg "$@"
