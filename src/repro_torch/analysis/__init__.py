"""Static analysis over probabilistic models: graph IR, lints, coverage.

The subsystem is one recording pass (``build_model_graph``, on the port's
own dataflow tracer, ``analysis.tracer``) with three consumers: lint
passes (``run_lints``), fusion-coverage classification
(``fusion_coverage``), and the bundled report (``analyze_model`` /
``Model.analyze()``). ``python -m repro_torch.analyze`` is the CLI
front-end.
"""
from repro_torch.analysis.coverage import (CoverageReport, OP_NAMES,
                                           SiteCoverage, fusion_coverage)
from repro_torch.analysis.graph import (GraphNode, ModelGraph,
                                        build_model_graph)
from repro_torch.analysis.lints import LINT_PASSES, LintFinding, run_lints
from repro_torch.analysis.report import (ANALYSIS_SCHEMA_VERSION,
                                         ModelAnalysis, analyze_model,
                                         build_analysis_report, machine_info,
                                         validate_analysis_report,
                                         write_analysis_report)

__all__ = [
    "ModelGraph", "GraphNode", "build_model_graph",
    "LintFinding", "LINT_PASSES", "run_lints",
    "SiteCoverage", "CoverageReport", "fusion_coverage", "OP_NAMES",
    "ModelAnalysis", "analyze_model", "build_analysis_report",
    "machine_info", "validate_analysis_report", "write_analysis_report",
    "ANALYSIS_SCHEMA_VERSION",
]
