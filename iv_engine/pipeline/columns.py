"""Channel layout of a packed ticker batch ``(B, C, L)``, shared by the
host packer (``ingest``) and the device kernels (``tasks``) without
pulling the host's table libraries into the device side."""

INTERP_COLS = ("iv", "underlying_price", "time_to_maturity")
FFILL_COLS = ("interest_rate", "mark_price", "index_price", "volume",
              "quote_volume")
ALL_COLS = INTERP_COLS + FFILL_COLS
