"""The benchmark's harness: process plumbing, the traffic generator, the
serving and training drivers, the profiled slice, the counts and the
comparisons that decide ``correct``."""
