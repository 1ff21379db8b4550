"""The trace context of graftledger; the rest of ``ledger/`` comes with the
serving-stack slice (ROADMAP.md queue 1 item 7)."""
