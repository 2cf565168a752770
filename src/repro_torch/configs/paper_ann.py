"""The paper's own 'architecture': filtered-ANN engine configurations for
the four evaluation datasets (Table 1)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    name: str
    n: int
    dim: int
    filter_kinds: tuple
    n_lists: int = 0        # 0 -> sqrt(N)
    k: int = 10


ANN_CONFIGS = {
    "arxiv": AnnConfig("arxiv", 2_140_000, 384, ("mixed", "label", "range")),
    "wolt": AnnConfig("wolt", 1_720_000, 512, ("range",)),
    "glove200": AnnConfig("glove200", 1_180_000, 200, ("range",)),
    "sift": AnnConfig("sift", 1_000_000, 128, ("range",)),
}
