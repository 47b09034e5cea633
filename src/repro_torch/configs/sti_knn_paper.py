"""The paper's own workload as a lowerable production cell: STI-KNN over
backbone embeddings at cluster scale (n = 65 536 train points, d = 768
features, k = 5; test points streamed in chunks of 4 096 per step).

Copy of `repro.configs.sti_knn_paper` for the PyTorch port."""
from dataclasses import dataclass


@dataclass(frozen=True)
class STIConfig:
    name: str = "sti-knn-paper"
    n_train: int = 65536
    feat_dim: int = 768
    k: int = 5
    test_chunk: int = 4096     # global test points per lowered step
    mode: str = "sti"


CONFIG = STIConfig()
