"""Token data pipeline (mirrors ``repro/data``)."""
