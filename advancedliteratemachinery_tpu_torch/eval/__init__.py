"""Host-side evaluation helpers."""
