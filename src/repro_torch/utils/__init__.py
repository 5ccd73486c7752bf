"""Analysis utilities: per-op step statistics, the H100 roofline model."""
