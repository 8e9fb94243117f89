"""The memory runtime: the device budget, the spill store, the retry
framework, the task semaphore, the host budget and its pinned staging
pool."""
