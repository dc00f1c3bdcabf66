from .builder import BUILDERS, NativeOpBuilder, get_native_lib, native_available

__all__ = ["BUILDERS", "NativeOpBuilder", "get_native_lib", "native_available"]
