# Quarter-res Ray-SD AO + guided upsample + TAA (BASELINE config 4 shape):
# SVAO runs on 1/4-res inputs, AOGuidedBlur upsamples against full-res depth.
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _graphlib import build

PASSES = [
    ('GBufferRaster', 'GBufferRaster', dict(sampleCount=8, cull='Back')),
    ('LinearizeDepth', 'LinearizeDepth', {}),
    ('GuardBand', 'GuardBand', dict(guardBand=64)),
    ('DownZ', 'DownsamplePass', dict(factor=4, mode='point')),
    ('DownN', 'DownsamplePass', dict(factor=4, mode='point')),
    ('CompressNormals', 'CompressNormals', dict(viewSpace=True, use16Bit=True)),
    ('DownGZ', 'DownsamplePass', dict(factor=4, mode='point')),
    ('SVAO', 'SVAO', dict(radius=0.2, secondaryDepthMode='StochasticDepth',
                          stochasticDepthImpl='Ray', stochMapDivisor=4,
                          stochMapGuardBand=128, exponent=2.0, dualAO=True)),
    ('AOGuidedBlur', 'AOGuidedBlur', dict(kernelRadius=4)),
    ('EnvMapPass', 'EnvMapPass', {}),
    ('RayShadow', 'RayShadow', {}),
    ('ForwardLighting', 'ForwardLighting', dict(envMapIntensity=0.25, ambientIntensity=0.25, lightIntensity=0.5)),
    ('ToneMapper', 'ToneMapper', dict(operator='Linear', clamp=False)),
    ('Shaded', 'ImageEquation', dict(formula='I0[xy].r * I1[xy]', format='RGBA32Float')),
    ('AmbientOcclusion', 'ImageEquation', dict(formula='I0[xy].rrra', format='RGBA32Float')),
    ('ShadedTAA', 'TAA', dict(alpha=0.1, colorBoxSigma=0.5, antiFlicker=True)),
]

EDGES = [
    ('GuardBand', 'GBufferRaster'),
    ('GBufferRaster.depth', 'LinearizeDepth.depth'),
    ('LinearizeDepth.linearDepth', 'DownZ.input'),
    ('GBufferRaster.faceNormalW', 'DownN.input'),
    ('DownN.output', 'CompressNormals.normalW'),
    ('GBufferRaster.depth', 'DownGZ.input'),
    ('DownGZ.output', 'SVAO.gbufferDepth'),
    ('DownZ.output', 'SVAO.depth'),
    ('DownZ.output', 'SVAO.depth2'),
    ('CompressNormals.normalOut', 'SVAO.normals'),
    ('SVAO.ao', 'AOGuidedBlur.in'),
    ('LinearizeDepth.linearDepth', 'AOGuidedBlur.depth'),
    ('GBufferRaster.depth', 'EnvMapPass.depth'),
    ('GBufferRaster.posW', 'RayShadow.posW'),
    ('GBufferRaster.normW', 'RayShadow.normalW'),
    ('GBufferRaster.depth', 'ForwardLighting.depth'),
    ('EnvMapPass.color', 'ForwardLighting.color'),
    ('RayShadow.visibility', 'ForwardLighting.visibilityBuffer'),
    ('ForwardLighting.color', 'ToneMapper.src'),
    ('AOGuidedBlur.out', 'Shaded.I0'),
    ('AOGuidedBlur.out', 'AmbientOcclusion.I0'),
    ('ToneMapper.dst', 'Shaded.I1'),
    ('Shaded.out', 'ShadedTAA.colorIn'),
    ('GBufferRaster.mvec', 'ShadedTAA.motionVecs'),
]

g = build('SVAO_quarter', PASSES, EDGES,
          ['ShadedTAA.colorOut', 'AmbientOcclusion.out'])
try:
    m.addGraph(g)
except NameError:
    pass
