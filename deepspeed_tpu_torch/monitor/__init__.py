from .monitor import CsvMonitor, MonitorMaster, TensorBoardMonitor, WandbMonitor, csvMonitor

__all__ = ["MonitorMaster", "CsvMonitor", "csvMonitor", "TensorBoardMonitor", "WandbMonitor"]
