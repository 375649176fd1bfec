# SVAO_small.py with the rasterized stochastic depth map (BASELINE config 2:
# SVAO stochasticDepthImpl Raster, set by the configuration's overrides): the
# same graph, its SVAO the reference's SVAORasterSD.
import importlib
import os
import runpy
import sys
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from _graphlib import build

import falcor

# registers SVAORasterSD, the SVAO that admits the raster SD map
importlib.import_module(falcor.__name__.rsplit(".", 1)[0]
                        + ".passes.svao_raster_sd")

# SVAO_small.py's tables, run without `m` (its addGraph is skipped)
SMALL = runpy.run_path(os.path.join(HERE, "SVAO_small.py"))
PASSES = [(name, 'SVAORasterSD' if name == 'SVAO' else ptype, props)
          for name, ptype, props in SMALL['PASSES']]
EDGES, OUTPUTS = SMALL['EDGES'], SMALL['OUTPUTS']

SVAO = build('SVAO', PASSES, EDGES, OUTPUTS)
try:
    m.addGraph(SVAO)
except NameError:
    pass
