"""The data tools on the port's NetCDF and HTK code (data/netcdf3.py,
writers.read_htk): copies of lstm_rnn_tpu/tools, which import the JAX
package, with the same command lines and the same output bytes."""
