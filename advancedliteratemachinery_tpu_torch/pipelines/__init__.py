from advancedliteratemachinery_tpu_torch.pipelines.modules import (
    FormulaRecognition,
    LayoutAnalysis,
    TableStructureRecognition,
    TextDetection,
    TextRecognition,
    crop_image,
    order_point,
)
from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
    load_document,
    load_image,
    load_pdf,
)
from advancedliteratemachinery_tpu_torch.pipelines.document import (
    DocumentStructurization,
    GeneralTextReading,
    TableParsing,
    cells_to_html,
    convert_document,
    sort_reading_order,
)

__all__ = [
    "FormulaRecognition", "LayoutAnalysis", "TableStructureRecognition",
    "TextDetection", "TextRecognition", "crop_image", "order_point",
    "DocumentStructurization", "GeneralTextReading", "TableParsing",
    "cells_to_html", "convert_document", "sort_reading_order",
    "load_document", "load_image", "load_pdf",
]
