from .sparsity_config import (BigBirdSparsityConfig,  # noqa: F401
                              BSLongformerSparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, SparsityConfig,
                              VariableSparsityConfig)
from ..block_sparse_attention import sparse_attention  # noqa: F401
