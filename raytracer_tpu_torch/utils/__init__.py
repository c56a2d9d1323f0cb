"""Utilities: runtime stats, named timers, PNG IO, profiling hooks."""
