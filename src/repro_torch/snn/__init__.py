"""The spiking models the port trains: the paper's MLPs and the conv
family, as init / forward / loss (and ``layer_specs`` for ``map_model``)."""

from repro_torch.snn.mlp import (SNNConfig, init_snn, snn_forward,  # noqa: F401
                                 snn_forward_batch_major, snn_loss)
from repro_torch.snn.conv import (ConvSNNConfig, conv_snn_forward,  # noqa: F401
                                  conv_snn_loss, init_conv_snn, layer_specs)
