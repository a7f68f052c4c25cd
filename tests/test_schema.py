"""Schema DDL contracts (the Postgres adapter's table definitions)."""

from iv_engine.pipeline import MemoryStore
from iv_engine.pipeline import storage as st
from iv_engine.pipeline.schema import (
    CANDLE_COLUMNS,
    DDL,
    INTERPOLATED_COLUMNS,
    RECONSTRUCTED_COLUMNS,
    TICKERS_COLUMNS,
    create_tables,
)


def test_ddl_covers_all_tables():
    assert set(DDL) == {st.TICKERS, st.INTERPOLATED, st.MINUTE_CANDLES,
                        st.RECONSTRUCTED}


def test_ddl_preserves_reference_constraints():
    for t in (st.MINUTE_CANDLES, st.RECONSTRUCTED):
        assert "valid_ohlc" in DDL[t]
        assert "positive_volume" in DDL[t]
    assert "UNIQUE (symbol, date)" in DDL[st.INTERPOLATED]
    assert "UNIQUE (symbol, timestamp, frequency)" in DDL[st.RECONSTRUCTED]
    for g in ("delta", "gamma", "theta", "vega", "rho"):
        assert g in DDL[st.INTERPOLATED]
    assert "is_interpolated" in DDL[st.INTERPOLATED]
    assert "batch_id" in DDL[st.INTERPOLATED]


def test_column_contracts_align_with_ddl():
    for col in INTERPOLATED_COLUMNS:
        assert col in DDL[st.INTERPOLATED], col
    for col in TICKERS_COLUMNS:
        assert col in DDL[st.TICKERS], col
    for col in CANDLE_COLUMNS:
        assert col in DDL[st.MINUTE_CANDLES], col
    for col in RECONSTRUCTED_COLUMNS:
        assert col in DDL[st.RECONSTRUCTED], col


def test_create_tables_noop_for_schemaless_store():
    stmts = create_tables(MemoryStore())
    assert len(stmts) == 4
