"""The assigned input-shape grid (seq_len x global_batch per kind).

Copy of `repro.configs.shapes` for the PyTorch port."""

from repro_torch.configs.base import ShapeSpec

__all__ = ["TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "ALL_SHAPES", "SHAPES", "LONG_CAPABLE", "shapes_for"]

TRAIN_4K = ShapeSpec("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeSpec("prefill_32k", seq_len=32768, global_batch=32,
                        kind="prefill")
DECODE_32K = ShapeSpec("decode_32k", seq_len=32768, global_batch=128,
                       kind="decode")
LONG_500K = ShapeSpec("long_500k", seq_len=524288, global_batch=1,
                      kind="decode")

ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES = {s.name: s for s in ALL_SHAPES}

# long_500k needs sub-quadratic attention: run only for SSM / hybrid /
# sliding-window archs; pure full-attention archs skip.
LONG_CAPABLE = {"mixtral-8x7b", "xlstm-1.3b", "jamba-v0.1-52b"}


def shapes_for(arch_name: str):
    """The grid's cells for `arch_name`: the three 32k-and-under shapes,
    and long_500k for the sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_name in LONG_CAPABLE:
        out.append(LONG_500K)
    return out
