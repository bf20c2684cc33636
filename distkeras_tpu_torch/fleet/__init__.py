"""Fleet plumbing of the port: the bind-probed port pool. The scheduler
and elastic jobs come with later slices."""
