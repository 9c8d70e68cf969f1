"""Run utilities: TensorBoard event files, gin-style bindings, profiling."""
