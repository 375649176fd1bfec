# Minimal SVAO demo pipeline — the README's four outputs (ShadedTAA /
# AmbientOcclusionTAA / Shaded / AmbientOcclusion). Pass names and wiring
# follow the reference's SVAO_small graph (SURVEY §2.4).
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _graphlib import build

SVAO_PROPS = dict(radius=0.2, primaryDepthMode='SingleDepth',
                  secondaryDepthMode='StochasticDepth', exponent=2.0,
                  rayPipeline=True, thickness=0.0, stochMapDivisor=4,
                  dualAO=False, alphaTest=True)

PASSES = [
    ('GBufferRaster', 'GBufferRaster', dict(sampleCount=8, useAlphaTest=True, cull='Back')),
    ('LinearizeDepth', 'LinearizeDepth', {}),
    ('RayShadow', 'RayShadow', {}),
    ('DepthPeeling', 'DepthPeeling', dict(cullMode='Back', minSeparationDistance=0.01)),
    ('GuardBand', 'GuardBand', dict(guardBand=64)),
    ('ToneMapper', 'ToneMapper', dict(operator='Linear', clamp=False)),
    ('SVAO', 'SVAO', SVAO_PROPS),
    ('CrossBilateralBlur0', 'CrossBilateralBlur', {}),
    ('Shaded', 'ImageEquation', dict(formula='I0[xy].r * I1[xy]', format='RGBA32Float')),
    ('AmbientOcclusion', 'ImageEquation', dict(formula='I0[xy].rrra', format='RGBA32Float')),
    ('ShadedTAA', 'TAA', dict(alpha=0.1, colorBoxSigma=0.5, antiFlicker=True)),
    ('AmbientOcclusionTAA', 'TAA', dict(alpha=0.1, colorBoxSigma=1.0, antiFlicker=True)),
    ('ForwardLighting', 'ForwardLighting', dict(envMapIntensity=0.25, ambientIntensity=0.25, lightIntensity=0.5)),
    ('EnvMapPass', 'EnvMapPass', {}),
    ('CompressNormals', 'CompressNormals', dict(viewSpace=True, use16Bit=True)),
    ('LinearizeDepth0', 'LinearizeDepth', {}),
]

EDGES = [
    ('GBufferRaster.posW', 'RayShadow.posW'),
    ('GBufferRaster.normW', 'RayShadow.normalW'),
    ('GBufferRaster.depth', 'LinearizeDepth.depth'),
    ('GBufferRaster.depth', 'SVAO.gbufferDepth'),
    ('ToneMapper.dst', 'SVAO.color'),
    ('LinearizeDepth.linearDepth', 'DepthPeeling.linearZ'),
    ('GuardBand', 'GBufferRaster'),
    ('SVAO.ao', 'CrossBilateralBlur0.color'),
    ('LinearizeDepth.linearDepth', 'CrossBilateralBlur0.linear depth'),
    ('ToneMapper.dst', 'Shaded.I1'),
    ('Shaded.out', 'ShadedTAA.colorIn'),
    ('AmbientOcclusion.out', 'AmbientOcclusionTAA.colorIn'),
    ('GBufferRaster.mvec', 'AmbientOcclusionTAA.motionVecs'),
    ('GBufferRaster.mvec', 'ShadedTAA.motionVecs'),
    ('GBufferRaster.depth', 'ForwardLighting.depth'),
    ('GBufferRaster.depth', 'EnvMapPass.depth'),
    ('EnvMapPass.color', 'ForwardLighting.color'),
    ('ForwardLighting.color', 'ToneMapper.src'),
    ('GBufferRaster.faceNormalW', 'CompressNormals.normalW'),
    ('RayShadow.visibility', 'ForwardLighting.visibilityBuffer'),
    ('DepthPeeling.depth2', 'LinearizeDepth0.depth'),
    ('LinearizeDepth0.linearDepth', 'SVAO.depth2'),
    ('CompressNormals.normalOut', 'SVAO.normals'),
    ('LinearizeDepth.linearDepth', 'SVAO.depth'),
    ('CrossBilateralBlur0.colorOut', 'Shaded.I0'),
    ('CrossBilateralBlur0.colorOut', 'AmbientOcclusion.I0'),
]

OUTPUTS = ['ShadedTAA.colorOut', 'AmbientOcclusionTAA.colorOut',
           'Shaded.out', 'AmbientOcclusion.out']

SVAO = build('SVAO', PASSES, EDGES, OUTPUTS)
try:
    m.addGraph(SVAO)
except NameError:
    pass
