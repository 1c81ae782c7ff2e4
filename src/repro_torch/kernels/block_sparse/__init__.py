from .ops import (column_table, compile_mask, expand_mask,  # noqa: F401
                  mask_from_weights, matmul, matmul_plain, sparse_savings)
