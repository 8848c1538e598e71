"""shadowing-tpu: Path Shadowing Monte Carlo in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``RudyMorel/shadowing`` (Path Shadowing Monte Carlo, arXiv:2308.01486) plus
the ``scatspectra`` surface it consumes: dataset generation (scattering
spectra synthesis, MRW, PDV), the fused shadow search, volatility
prediction, and Hedged-Monte-Carlo option pricing.

The public API mirrors the reference's concepts so its users can switch
directly; the implementations are dense, statically shaped device programs
(see module docstrings).
"""

__version__ = "0.1.0"

from shadowing_tpu.array_types import Array as ArrayType  # reference alias
from shadowing_tpu.array_types import Array, as_numpy, dim_bct
from shadowing_tpu.data.dataset import TimeSeriesDataset, batch_npy_files
from shadowing_tpu.data.price_data import PriceData
from shadowing_tpu.data.snp import SPDaily
from shadowing_tpu.data.windows import windows
from shadowing_tpu.shadow.context import (
    ContextManager,
    CrossChannelContext,
    ImputationContext,
    PredictionContext,
)
from shadowing_tpu.shadow.distance import (
    CosineDistance,
    MSE,
    PathDistance,
    RelativeMSE,
)
from shadowing_tpu.shadow.embedding import Foveal, Identity, PathEmbedding
from shadowing_tpu.shadow.engine import PathShadowing
from shadowing_tpu.stats.proba import DiscreteProba, Softmax, Uniform
from shadowing_tpu.stats.realized import get_RV, realized_variance

_LAZY = {
    # parallel (mesh sharding)
    "data_mesh": "shadowing_tpu.parallel.sharding",
    "shard_dataset": "shadowing_tpu.parallel.sharding",
    "sharded_fused_search": "shadowing_tpu.parallel.sharding",
    "sharded_synthesis_step": "shadowing_tpu.parallel.sharding",
    # workflows
    "rolling_backtest": "shadowing_tpu.backtest",
    "BacktestResult": "shadowing_tpu.backtest",
    # generators
    "MRWGenerator": "shadowing_tpu.models.mrw",
    "generate": "shadowing_tpu.models.scattering.generate",
    "analyze": "shadowing_tpu.models.scattering.generate",
    "PDVModel": "shadowing_tpu.models.pdv",
    "PDVModelDiscrete": "shadowing_tpu.models.pdv",
    "AutoregressiveLinearPredictor": "shadowing_tpu.models.pdv",
    "compute_factor": "shadowing_tpu.models.pdv",
    "future_pdv_model": "shadowing_tpu.models.pdv",
    "kernel_exp": "shadowing_tpu.models.pdv",
    "kernel_pl": "shadowing_tpu.models.pdv",
    "DEFAULT1": "shadowing_tpu.models.pdv",
    "DEFAULT2": "shadowing_tpu.models.pdv",
    # pricing
    "compute_smile": "shadowing_tpu.pricing.hedged_mc",
    "compute_smile_batch": "shadowing_tpu.pricing.hedged_mc",
    "Smile": "shadowing_tpu.pricing.hedged_mc",
    # visualisation (imports matplotlib lazily)
    "plot_closest": "shadowing_tpu.viz.plots",
    "plot_shadow": "shadowing_tpu.viz.plots",
    "plot_volatility": "shadowing_tpu.viz.plots",
    "plot_dashboard": "shadowing_tpu.viz.plots",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Array",
    "ArrayType",
    "ContextManager",
    "CosineDistance",
    "CrossChannelContext",
    "DiscreteProba",
    "Foveal",
    "Identity",
    "ImputationContext",
    "MSE",
    "PathDistance",
    "PathEmbedding",
    "PathShadowing",
    "PredictionContext",
    "PriceData",
    "RelativeMSE",
    "SPDaily",
    "Softmax",
    "TimeSeriesDataset",
    "Uniform",
    "as_numpy",
    "batch_npy_files",
    "dim_bct",
    "get_RV",
    "realized_variance",
    "windows",
    *_LAZY,
]
