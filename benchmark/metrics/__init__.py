"""Per-layer metric readers, one file a metric, and their frozen arithmetic."""
