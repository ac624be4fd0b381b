"""The dense metric store."""
