"""Host-side utilities: stage timers and traces, logging, the native IO
library's bridge."""
