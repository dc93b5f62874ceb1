"""Job drivers, one module per traffic kind: run(ctx) sets up the
program, measures the window and checks its outputs (harness.Context)."""
