"""ZeRO config (only stage 0 is ported)."""
