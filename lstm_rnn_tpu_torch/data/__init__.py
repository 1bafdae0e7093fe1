from lstm_rnn_tpu_torch.data.netcdf3 import NetCDF3File, read_netcdf, write_netcdf  # noqa: F401
from lstm_rnn_tpu_torch.data.dataset import DataSet, Fraction  # noqa: F401
