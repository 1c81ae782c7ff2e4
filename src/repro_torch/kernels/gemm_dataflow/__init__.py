from .ops import (Dataflow, matmul, matmul_plain, matmul_ref,  # noqa: F401
                  modeled_traffic)
