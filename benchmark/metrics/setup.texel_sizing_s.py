"""Host seconds of the program's set-up span `smt.setup.texel_sizing`: a
`TexelsRenderer`'s texel resolutions over every frame's camera, up to
their read to the host. The program's own timer; nothing where the
program has none."""

from benchmark import spans


def read(ctx):
    return spans.setup_s("smt.setup.texel_sizing")
