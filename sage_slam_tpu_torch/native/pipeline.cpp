// Native runtime of sage_slam_tpu_torch (a copy of sage_slam_tpu's
// native/pipeline.cpp) — C++ counterpart of the reference's pthread
// architecture (deepfactors.cpp:1495-1505: frontend + mapping +
// local/global loop threads with rate control), plus hot host-side
// geometry (convex hull — the boost::geometry usage in
// camera_tracker.cpp:131-155).
//
// Exposed as a plain C API loaded with ctypes. Python callbacks are
// invoked from OS threads; the Python side wraps them with CFUNCTYPE,
// which takes the GIL for each call.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
typedef void (*rt_task_fn)(void *ctx);
}

namespace {

using clock_t_ = std::chrono::steady_clock;

struct Worker {
  std::thread thread;
  std::atomic<bool> stop{false};
  std::string name;
};

struct Runtime {
  std::vector<Worker *> workers;
  std::mutex mutex;
};

struct TaskQueue {
  std::deque<int64_t> items;
  std::mutex mutex;
  std::condition_variable cv;
  std::atomic<bool> closed{false};
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- runtime

void *rt_create() { return new Runtime(); }

void rt_destroy(void *h) {
  auto *rt = static_cast<Runtime *>(h);
  for (auto *w : rt->workers) {
    w->stop.store(true);
    if (w->thread.joinable()) w->thread.join();
    delete w;
  }
  delete rt;
}

// Spawn a rate-controlled worker: calls fn(ctx) at most `frequency_hz`
// times per second until stopped (the MappingBackend /
// LoopDetectBackend loop shape, deepfactors.cpp:1248-1306).
void *rt_spawn_worker(void *h, const char *name, rt_task_fn fn, void *ctx,
                      double frequency_hz) {
  auto *rt = static_cast<Runtime *>(h);
  auto *w = new Worker();
  w->name = name ? name : "worker";
  double period_s = frequency_hz > 0 ? 1.0 / frequency_hz : 0.0;
  w->thread = std::thread([w, fn, ctx, period_s]() {
    while (!w->stop.load(std::memory_order_relaxed)) {
      auto start = clock_t_::now();
      fn(ctx);
      if (period_s > 0) {
        auto elapsed =
            std::chrono::duration<double>(clock_t_::now() - start).count();
        double sleep_s = period_s - elapsed;
        if (sleep_s > 0) {
          std::this_thread::sleep_for(
              std::chrono::duration<double>(sleep_s));
        }
      }
    }
  });
  std::lock_guard<std::mutex> lock(rt->mutex);
  rt->workers.push_back(w);
  return w;
}

void rt_stop_worker(void *wh) {
  static_cast<Worker *>(wh)->stop.store(true);
}

void rt_stop_all(void *h) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lock(rt->mutex);
  for (auto *w : rt->workers) w->stop.store(true);
}

void rt_join_all(void *h) {
  auto *rt = static_cast<Runtime *>(h);
  std::lock_guard<std::mutex> lock(rt->mutex);
  for (auto *w : rt->workers) {
    if (w->thread.joinable()) w->thread.join();
  }
}

// ------------------------------------------------------------ task queue

void *rt_queue_create() { return new TaskQueue(); }

void rt_queue_destroy(void *qh) { delete static_cast<TaskQueue *>(qh); }

void rt_queue_push(void *qh, int64_t item) {
  auto *q = static_cast<TaskQueue *>(qh);
  {
    std::lock_guard<std::mutex> lock(q->mutex);
    q->items.push_back(item);
  }
  q->cv.notify_one();
}

// Pop with timeout; returns -1 on timeout / closed-and-empty.
int64_t rt_queue_pop(void *qh, int64_t timeout_ms) {
  auto *q = static_cast<TaskQueue *>(qh);
  std::unique_lock<std::mutex> lock(q->mutex);
  if (!q->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), [q]() {
        return !q->items.empty() || q->closed.load();
      })) {
    return -1;
  }
  if (q->items.empty()) return -1;
  int64_t item = q->items.front();
  q->items.pop_front();
  return item;
}

int64_t rt_queue_size(void *qh) {
  auto *q = static_cast<TaskQueue *>(qh);
  std::lock_guard<std::mutex> lock(q->mutex);
  return static_cast<int64_t>(q->items.size());
}

void rt_queue_close(void *qh) {
  auto *q = static_cast<TaskQueue *>(qh);
  q->closed.store(true);
  q->cv.notify_all();
}

// ----------------------------------------------------- geometry utilities

// Monotone-chain convex hull area over N (x, y) float pairs.
double rt_convex_hull_area(const float *pts, int64_t n) {
  if (n < 3) return 0.0;
  std::vector<std::pair<double, double>> p(n);
  for (int64_t i = 0; i < n; ++i) p[i] = {pts[2 * i], pts[2 * i + 1]};
  std::sort(p.begin(), p.end());
  p.erase(std::unique(p.begin(), p.end()), p.end());
  int64_t m = p.size();
  if (m < 3) return 0.0;
  auto cross = [](const std::pair<double, double> &o,
                  const std::pair<double, double> &a,
                  const std::pair<double, double> &b) {
    return (a.first - o.first) * (b.second - o.second) -
           (a.second - o.second) * (b.first - o.first);
  };
  std::vector<std::pair<double, double>> hull(2 * m);
  int64_t k = 0;
  for (int64_t i = 0; i < m; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], p[i]) <= 0) k--;
    hull[k++] = p[i];
  }
  for (int64_t i = m - 2, t = k + 1; i >= 0; --i) {
    while (k >= t && cross(hull[k - 2], hull[k - 1], p[i]) <= 0) k--;
    hull[k++] = p[i];
  }
  hull.resize(k - 1);
  double area = 0.0;
  for (size_t i = 0; i < hull.size(); ++i) {
    auto &a = hull[i];
    auto &b = hull[(i + 1) % hull.size()];
    area += a.first * b.second - b.first * a.second;
  }
  return std::abs(area) * 0.5;
}

// Median of a float array (nth_element; used for depth-scale init).
float rt_median(const float *vals, int64_t n) {
  if (n == 0) return 0.0f;
  std::vector<float> v(vals, vals + n);
  auto mid = v.begin() + n / 2;
  std::nth_element(v.begin(), mid, v.end());
  if (n % 2 == 1) return *mid;
  float hi = *mid;
  float lo = *std::max_element(v.begin(), mid);
  return 0.5f * (lo + hi);
}

}  // extern "C"
