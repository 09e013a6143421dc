from .pipeline import PipelineSchedule, pipeline_apply  # noqa: F401
