"""AdamW and int8 gradient compression with error feedback, over the
port's parameter trees."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compress import (CompressionConfig, compress_gradients,  # noqa: F401
                                        decompress_gradients)
