"""AdamW and the int8 + error-feedback gradient compression of the port."""

from repro_torch.optim.adamw import (  # noqa: F401
    init_opt_state,
    adamw_update,
    lr_schedule,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_int8,
    decompress_int8,
    CompressedAllReduce,
)
