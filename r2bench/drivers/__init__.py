"""One driver a kind of entry point of the program: ``train`` and ``serve``.
A cell's ``workloads/<cell>.json`` names its driver; ``run(ctx)`` sets the
cell up, measures the window and checks it against the reference."""
