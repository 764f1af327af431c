"""The benchmark of classpp_public_torch: one cell of BENCHMARK.json run once.

`manifest` resolves cells, configurations, traffic mixes, their generators
and metric readers by name; `traffic` hands a mix to its generator; `session`
runs set-up, the measured window, the traced run's spans and the comparison
with the plain reference (`reference`, `compare`); `trace` reduces the
profiler's events; `roofline` holds the work counts and the card's peaks;
`guard` keeps JAX out of the measured process.
"""
