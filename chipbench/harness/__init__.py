"""The benchmark's harness: spec, traffic, weights, runs, tracing and the
yardstick's arithmetic. Imports torch, numpy and the program under test
(``repro_torch``), never JAX or the JAX package."""
