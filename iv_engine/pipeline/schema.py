"""Table schemas / DDL — the reference's SchemaManager + CandleSchemaManager
(src/database/schema.py:7-119, src/database/candle_schema.py:7-171) for the
Postgres adapter, plus canonical column contracts the other adapters share.

DDL preserves the reference's constraints: ``valid_ohlc`` and
``positive_volume`` CHECKs (candle_schema.py:41-48), unique keys on
``(symbol, date)`` / ``(symbol, timestamp[, frequency])``, the reserved
Greeks columns (schema.py:36-41 — populated for real here), and the
supporting indexes (schema.py:56-69).
"""

from __future__ import annotations

from iv_engine.pipeline import storage as st

# canonical column contracts (all adapters)
TICKERS_COLUMNS = [
    "symbol", "date", "iv", "underlying_price", "time_to_maturity",
    "strike", "callput", "interest_rate", "mark_price", "index_price",
    "volume", "quote_volume",
]
INTERPOLATED_COLUMNS = TICKERS_COLUMNS + [
    "delta", "gamma", "theta", "vega", "rho", "is_interpolated", "batch_id",
]
CANDLE_COLUMNS = ["symbol", "timestamp", "open", "high", "low", "close",
                  "volume"]
RECONSTRUCTED_COLUMNS = CANDLE_COLUMNS + ["frequency", "source_candles",
                                          "created_at"]

_OHLC_CHECKS = """
    CONSTRAINT valid_ohlc CHECK (
        high >= low AND high >= open AND high >= close
        AND low <= open AND low <= close
    ),
    CONSTRAINT positive_volume CHECK (volume >= 0)
"""

DDL = {
    st.TICKERS: f"""
CREATE TABLE IF NOT EXISTS {st.TICKERS} (
    id BIGSERIAL PRIMARY KEY,
    symbol VARCHAR(100) NOT NULL,
    date TIMESTAMP NOT NULL,
    iv DOUBLE PRECISION,
    underlying_price DOUBLE PRECISION,
    time_to_maturity DOUBLE PRECISION,
    strike DOUBLE PRECISION,
    callput VARCHAR(10),
    interest_rate DOUBLE PRECISION,
    mark_price DOUBLE PRECISION,
    index_price DOUBLE PRECISION,
    volume DOUBLE PRECISION,
    quote_volume DOUBLE PRECISION,
    UNIQUE (symbol, date)
);
CREATE INDEX IF NOT EXISTS idx_tickers_symbol_date
    ON {st.TICKERS} (symbol, date);
""",
    st.INTERPOLATED: f"""
CREATE TABLE IF NOT EXISTS {st.INTERPOLATED} (
    id BIGSERIAL PRIMARY KEY,
    symbol VARCHAR(100) NOT NULL,
    date TIMESTAMP NOT NULL,
    iv DOUBLE PRECISION,
    underlying_price DOUBLE PRECISION,
    time_to_maturity DOUBLE PRECISION,
    strike DOUBLE PRECISION,
    callput VARCHAR(10),
    interest_rate DOUBLE PRECISION,
    mark_price DOUBLE PRECISION,
    index_price DOUBLE PRECISION,
    volume DOUBLE PRECISION,
    quote_volume DOUBLE PRECISION,
    delta DOUBLE PRECISION,
    gamma DOUBLE PRECISION,
    theta DOUBLE PRECISION,
    vega DOUBLE PRECISION,
    rho DOUBLE PRECISION,
    is_interpolated BOOLEAN DEFAULT FALSE,
    batch_id BIGINT,
    UNIQUE (symbol, date)
);
CREATE INDEX IF NOT EXISTS idx_interp_symbol_date
    ON {st.INTERPOLATED} (symbol, date);
CREATE INDEX IF NOT EXISTS idx_interp_date ON {st.INTERPOLATED} (date);
CREATE INDEX IF NOT EXISTS idx_interp_symbol ON {st.INTERPOLATED} (symbol);
CREATE INDEX IF NOT EXISTS idx_interp_batch ON {st.INTERPOLATED} (batch_id);
""",
    st.MINUTE_CANDLES: f"""
CREATE TABLE IF NOT EXISTS {st.MINUTE_CANDLES} (
    id BIGSERIAL PRIMARY KEY,
    symbol VARCHAR(100) NOT NULL,
    timestamp TIMESTAMP NOT NULL,
    open DOUBLE PRECISION NOT NULL,
    high DOUBLE PRECISION NOT NULL,
    low DOUBLE PRECISION NOT NULL,
    close DOUBLE PRECISION NOT NULL,
    volume DOUBLE PRECISION DEFAULT 0,
    UNIQUE (symbol, timestamp),
    {_OHLC_CHECKS}
);
CREATE INDEX IF NOT EXISTS idx_minute_symbol_ts
    ON {st.MINUTE_CANDLES} (symbol, timestamp);
""",
    st.RECONSTRUCTED: f"""
CREATE TABLE IF NOT EXISTS {st.RECONSTRUCTED} (
    id BIGSERIAL PRIMARY KEY,
    symbol VARCHAR(100) NOT NULL,
    timestamp TIMESTAMP NOT NULL,
    open DOUBLE PRECISION NOT NULL,
    high DOUBLE PRECISION NOT NULL,
    low DOUBLE PRECISION NOT NULL,
    close DOUBLE PRECISION NOT NULL,
    volume DOUBLE PRECISION DEFAULT 0,
    frequency VARCHAR(10) NOT NULL,
    source_candles INTEGER,
    created_at TIMESTAMP,
    UNIQUE (symbol, timestamp, frequency),
    {_OHLC_CHECKS}
);
CREATE INDEX IF NOT EXISTS idx_recon_symbol_ts_freq
    ON {st.RECONSTRUCTED} (symbol, timestamp, frequency);
""",
}


def create_tables(store) -> list:
    """Create all pipeline tables (Postgres adapter only; memory/parquet
    adapters are schemaless — returns the DDL that would run)."""
    statements = [DDL[t] for t in (st.TICKERS, st.INTERPOLATED,
                                   st.MINUTE_CANDLES, st.RECONSTRUCTED)]
    if hasattr(store, "_connect"):  # PostgresStore
        with store._connect() as conn, conn.cursor() as cur:
            for ddl in statements:
                cur.execute(ddl)
            conn.commit()
    return statements
