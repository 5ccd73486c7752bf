"""One module per kind of traffic mix (a mix's ``kind``), each with
``run(ctx) -> Outcome``."""
