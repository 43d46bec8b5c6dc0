"""Traffic generators, one module per kind; a mix (``mixes/<name>.json``)
names its kind and holds its parameters. Sizes and arrival gaps come from
the mix's own ``sizes_seed``, so every run seed gets the same work; the run
seed draws the signals (and, where it changes no work, the order of
files)."""
