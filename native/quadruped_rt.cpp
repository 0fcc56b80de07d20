// quadruped_rt — native host runtime for the jitted JAX controller.
//
// The reference implements its whole controller in C++ behind a 6-function
// C ABI loaded via ctypes (reference src/GaitCtrller.h:63-99,
// scripts/walking_simulation.py:70-79). Here the *compute* runs on the
// accelerator through JAX; this library provides the native runtime around
// it:
//
//  * the same C ABI (init_controller / pre_work / set_gait_type /
//    set_robot_mode / set_robot_vel / torque_calculator) so a user of the
//    reference's ctypes interface can switch stacks without touching their
//    simulator loop;
//  * a lock-free SPSC command queue: the reference mutates controller state
//    from the ROS-spin thread while the control loop reads it, unguarded
//    (SURVEY.md §3.3); here async commands enqueue and are drained at the
//    top of each control tick by the consumer only;
//  * nanosecond timers + a latency histogram (p50/p99 against the 2 ms tick
//    budget), the production observability the reference lacks;
//  * a rate limiter for driving real-time loops.
//
// The controller computation is injected as a callback
// (quadruped_rt_register_compute) by the Python host, which wraps the jitted
// controller step. Everything here is plain C++17 + pthreads, no external deps.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <algorithm>

namespace {

constexpr int kNumJoints = 12;
constexpr int kImuLen = 10;
constexpr int kLegLen = 24;

// ---------------------------------------------------------------- timing --
inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

class LatencyHistogram {
 public:
  // 1 us resolution up to 1 ms, then 100 us up to 100 ms.
  static constexpr int kFine = 1000;
  static constexpr int kCoarse = 990;

  void record(int64_t ns) {
    int64_t us = ns / 1000;
    if (us < kFine) {
      fine_[us].fetch_add(1, std::memory_order_relaxed);
    } else {
      int64_t idx = (us - kFine) / 100;
      if (idx >= kCoarse) idx = kCoarse - 1;
      coarse_[idx].fetch_add(1, std::memory_order_relaxed);
    }
    count_.fetch_add(1, std::memory_order_relaxed);
    int64_t prev = max_ns_.load(std::memory_order_relaxed);
    while (ns > prev &&
           !max_ns_.compare_exchange_weak(prev, ns, std::memory_order_relaxed)) {
    }
    sum_ns_.fetch_add(ns, std::memory_order_relaxed);
  }

  double percentile_us(double q) const {
    int64_t total = count_.load(std::memory_order_relaxed);
    if (total == 0) return 0.0;
    int64_t target = static_cast<int64_t>(q / 100.0 * (total - 1)) + 1;
    int64_t seen = 0;
    for (int i = 0; i < kFine; i++) {
      seen += fine_[i].load(std::memory_order_relaxed);
      if (seen >= target) return static_cast<double>(i);
    }
    for (int i = 0; i < kCoarse; i++) {
      seen += coarse_[i].load(std::memory_order_relaxed);
      if (seen >= target) return kFine + (i + 0.5) * 100.0;
    }
    return max_ns_.load(std::memory_order_relaxed) / 1000.0;
  }

  int64_t count() const { return count_.load(std::memory_order_relaxed); }
  double mean_us() const {
    int64_t c = count();
    return c ? sum_ns_.load(std::memory_order_relaxed) / 1000.0 / c : 0.0;
  }
  double max_us() const { return max_ns_.load(std::memory_order_relaxed) / 1000.0; }

  void reset() {
    for (auto& b : fine_) b.store(0, std::memory_order_relaxed);
    for (auto& b : coarse_) b.store(0, std::memory_order_relaxed);
    count_.store(0);
    sum_ns_.store(0);
    max_ns_.store(0);
  }

 private:
  std::atomic<int64_t> fine_[kFine] = {};
  std::atomic<int64_t> coarse_[kCoarse] = {};
  std::atomic<int64_t> count_{0};
  std::atomic<int64_t> sum_ns_{0};
  std::atomic<int64_t> max_ns_{0};
};

// ----------------------------------------------------------- SPSC queue --
struct Cmd {
  int32_t kind;      // 0 = gait, 1 = mode, 2 = velocity
  int32_t ivalue;
  double vec[3];
};

template <int N>
class SpscQueue {
 public:
  bool push(const Cmd& c) {
    const uint32_t head = head_.load(std::memory_order_relaxed);
    const uint32_t next = (head + 1) % N;
    if (next == tail_.load(std::memory_order_acquire)) return false;  // full
    buf_[head] = c;
    head_.store(next, std::memory_order_release);
    return true;
  }

  bool pop(Cmd* out) {
    const uint32_t tail = tail_.load(std::memory_order_relaxed);
    if (tail == head_.load(std::memory_order_acquire)) return false;  // empty
    *out = buf_[tail];
    tail_.store((tail + 1) % N, std::memory_order_release);
    return true;
  }

 private:
  Cmd buf_[N];
  std::atomic<uint32_t> head_{0};
  std::atomic<uint32_t> tail_{0};
};

// ------------------------------------------------------------- controller --
// Python-registered compute callback: consumes (imu, leg, gait, mode, vel)
// and writes 12 torques. Returns 0 on success.
using ComputeFn = int (*)(const double* imu, const double* leg, int gait,
                          int mode, const double* vel, double* tau_out);

struct Runtime {
  double freq = 500.0;
  double ctrl_param[4] = {0, 0, 0, 0};
  ComputeFn compute = nullptr;
  SpscQueue<256> commands;
  // consumer-side (control-thread-only) command state
  int gait_type = 9;
  int robot_mode = 0;
  double vel[3] = {0, 0, 0};
  LatencyHistogram latency;
  std::atomic<int64_t> overruns{0};
  int64_t last_tick_ns = 0;

  void drain_commands() {
    Cmd c;
    while (commands.pop(&c)) {
      switch (c.kind) {
        case 0: gait_type = c.ivalue; break;
        case 1: robot_mode = c.ivalue; break;
        case 2:
          // the reference's +-0.03 deadband (GaitCtrller.cpp:75-93) is
          // applied inside the jitted controller; pass through raw
          std::memcpy(vel, c.vec, sizeof(vel));
          break;
      }
    }
  }
};

Runtime* g_rt = nullptr;

struct JointEff {
  double eff[kNumJoints];
};
JointEff g_eff;

}  // namespace

extern "C" {

// ------------------------------------------------ reference-compatible ABI
void init_controller(double freq, double* ctrl_param) {
  delete g_rt;
  g_rt = new Runtime();
  g_rt->freq = freq;
  for (int i = 0; i < 4; i++) g_rt->ctrl_param[i] = ctrl_param[i];
}

void quadruped_rt_register_compute(ComputeFn fn) {
  if (g_rt) g_rt->compute = fn;
}

void pre_work(double* imu, double* leg) {
  // estimator warm-up is part of the compute callback contract: a tick with
  // a null torque sink signals "estimate only"
  if (g_rt && g_rt->compute) {
    double tau[kNumJoints];
    g_rt->drain_commands();
    g_rt->compute(imu, leg, -1 /* pre-work sentinel */, g_rt->robot_mode,
                  g_rt->vel, tau);
  }
}

void set_gait_type(int gait) {
  if (g_rt) g_rt->commands.push(Cmd{0, gait, {0, 0, 0}});
}

void set_robot_mode(int mode) {
  if (g_rt) g_rt->commands.push(Cmd{1, mode, {0, 0, 0}});
}

void set_robot_vel(double* vel) {
  if (g_rt) g_rt->commands.push(Cmd{2, 0, {vel[0], vel[1], vel[2]}});
}

JointEff* torque_calculator(double* imu, double* leg) {
  if (!g_rt || !g_rt->compute) {
    std::memset(g_eff.eff, 0, sizeof(g_eff.eff));
    return &g_eff;
  }
  const int64_t t0 = now_ns();
  g_rt->drain_commands();
  g_rt->compute(imu, leg, g_rt->gait_type, g_rt->robot_mode, g_rt->vel,
                g_eff.eff);
  const int64_t dt = now_ns() - t0;
  g_rt->latency.record(dt);
  const double budget_ns = 1e9 / g_rt->freq;
  if (dt > budget_ns) g_rt->overruns.fetch_add(1, std::memory_order_relaxed);
  g_rt->last_tick_ns = t0;
  return &g_eff;
}

// --------------------------------------------------------- observability --
double quadruped_rt_latency_us(double percentile) {
  return g_rt ? g_rt->latency.percentile_us(percentile) : 0.0;
}
double quadruped_rt_latency_mean_us() {
  return g_rt ? g_rt->latency.mean_us() : 0.0;
}
double quadruped_rt_latency_max_us() {
  return g_rt ? g_rt->latency.max_us() : 0.0;
}
long long quadruped_rt_tick_count() {
  return g_rt ? g_rt->latency.count() : 0;
}
long long quadruped_rt_overruns() {
  return g_rt ? g_rt->overruns.load() : 0;
}
void quadruped_rt_reset_stats() {
  if (g_rt) {
    g_rt->latency.reset();
    g_rt->overruns.store(0);
  }
}

// ------------------------------------------------------------ rate limit --
// Sleep until the next multiple of (1/freq) after `anchor_ns`; returns the
// new anchor. Lets a host loop hold 500 Hz without drift.
long long quadruped_rt_sleep_until_next(long long anchor_ns) {
  const double period = g_rt ? 1e9 / g_rt->freq : 2e6;
  int64_t next = anchor_ns + static_cast<int64_t>(period);
  const int64_t now = now_ns();
  if (next <= now) return now;  // overrun: resync
  timespec ts;
  ts.tv_sec = next / 1000000000LL;
  ts.tv_nsec = next % 1000000000LL;
  clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr);
  return next;
}

long long quadruped_rt_now_ns() { return now_ns(); }

}  // extern "C"
