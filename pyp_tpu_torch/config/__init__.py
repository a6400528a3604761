"""Parameter schema, CLI parsing and project-file persistence."""
