"""Many-file engines: the batched, restartable corpus converter."""
