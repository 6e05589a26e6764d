"""Paper evaluation data (Serpens, Tables 2-3).

The port carries only the table that :mod:`repro_torch.data.matrices`
sizes its stand-in matrices from.  The figures are the paper's FPGA
measurements, not measurements of this package.
"""
from __future__ import annotations

# id: (name, vertices, nnz, serpens_ms, serpens_mteps, graphlily_mteps,
#      serpens_v24_mteps)
PAPER_TABLE3 = {
    "G1": ("googleplus", 108_000, 13_700_000, 1.87, 7_300, 7_920, 7_606),
    "G2": ("crankseg_2", 63_800, 14_100_000, 0.930, 15_214, 9_639, 17_943),
    "G3": ("Si41Ge41H72", 186_000, 15_000_000, 0.853, 17_594, 8_117, 22_262),
    "G4": ("TSOPF_RS_b2383", 38_100, 16_200_000, 0.730, 22_144, 10_296,
           30_204),
    "G5": ("ML_Laplace", 377_000, 27_600_000, 1.37, 20_099, 9_305, 25_796),
    "G6": ("mouse_gene", 45_100, 29_000_000, 1.37, 21_098, 10_331, 28_937),
    "G7": ("soc_pokec", 1_630_000, 30_600_000, 4.52, 6_782, 4_352, 8_708),
    "G8": ("coPapersCiteseer", 434_000, 21_100_000, 2.09, 15_324, 8_828,
           17_990),
    "G9": ("PFlow_742", 743_000, 37_100_000, 2.05, 18_142, 8_212, 22_969),
    "G10": ("ogbl_ppa", 576_000, 42_500_000, 2.04, 20_847, 9_243, 27_680),
    "G11": ("hollywood", 1_070_000, 113_000_000, 6.20, 18_176, 9_094, 22_330),
    "G12": ("ogbn_products", 2_450_000, 124_000_000, 6.32, 19_565, 6_668,
            25_278),
}
