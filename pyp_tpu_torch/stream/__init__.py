"""On-the-fly session processing (streaming daemons)."""
