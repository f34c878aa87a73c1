"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517].  d_ff=0: xLSTM blocks carry their own up/down
projections (no separate FFN).  Ratio 7 mLSTM : 1 sLSTM (xLSTM[7:1]).

Attention-free: runs the long_500k shape with O(1) recurrent state decode.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_kind="xlstm",
    slstm_every=8,              # blocks 7, 15, ... are sLSTM (7:1 ratio)
    ssm_expand=2,
    head_dim=512,               # 4 heads x 512 = expanded dim / expand
    rope=False,
    scan_layers=False,          # heterogeneous blocks (mLSTM vs sLSTM)
))
