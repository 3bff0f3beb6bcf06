"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM). [arXiv:2405.04517; unverified]

48L d_model=2048 4H (kv=4) d_ff=0 (projection sub-block lives inside each
xLSTM block) vocab=50304. Fully recurrent → O(1) decode state → runs
long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    ssm_kind="xlstm",
    slstm_every=8,
    source="arXiv:2405.04517; unverified",
)
