"""Samplers: DogStatsD parsing and the flushed-metric types."""
