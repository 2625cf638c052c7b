"""The plain reference of the benchmark: torch and numpy on the raw values
made again from the seed.  Nothing here imports the program under test;
it builds its own LSB-first words and counts.

Each traffic generator ``<g>`` has a module ``<g>`` here with

- ``columns(params)``: the columns it reads, the only ones made again;
- ``Truth(params, config, raw)``: ``numbers(op)`` (what the program's
  call reads on the host, in the same order) and ``words(op)`` (the
  bitvectors it leaves on the card, in the same order);
- ``compare(got, expected)``: ``{check name: number of mismatches}``;
- ``control_call(params, config, raw, op, span)``: the reference put in the
  program's place with one guarantee of the configuration broken, which
  the comparison must catch.
"""
