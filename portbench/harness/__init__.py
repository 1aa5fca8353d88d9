"""The benchmark's harness: finds a cell's configuration, traffic,
per-layer metrics and limits by name, drives the port under test, reads
its trace and decides `correct` against the plain reference."""
