from .benchmark import ALL_BENCHMARKS, SRBenchmark
from .degrade import bicubic_lr, generate_lr_pyramid
from .div2k import DIV2K
from .provider import Provider
from .synthetic import create_synthetic_dataset

__all__ = [
    "bicubic_lr",
    "generate_lr_pyramid",
    "ALL_BENCHMARKS",
    "SRBenchmark",
    "DIV2K",
    "Provider",
    "create_synthetic_dataset",
]
