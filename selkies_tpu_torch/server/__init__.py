"""Server plane of the port. Only the metrics registry
(:mod:`.metrics`) so far; the services come with ROADMAP A6."""
