from .ops import (LUT_ENTRIES, LUT_HI, LUT_LO, STEP, TABLES,  # noqa: F401
                  apply_lut, build_table, lut_activation, lut_plain,
                  quantize_u16, table_for)
